"""A project's train_hparams.yaml: read, edited line by line, written.

Port of `multiplanarunet_tpu/hyperparameters/hparams.py:YAMLHParams`: a
dict of config groups parsed from the file (groups prefixed __CB, the
callback anchor definitions, are dropped), the raw text, group lookup,
`get_from_anywhere`, and `set_value` / `save_current`, which rewrite
single lines of the raw text so that comments and anchors survive (the
Auditor writes the values it infers back this way). Parsing goes through
`yaml_reader.safe_load`. Unless no_version_control, loading a file warns
when its __VERSION__ differs from the installed one, then stamps
__VERSION__, __BRANCH__ and __COMMIT__ (`VersionController`: the
package's version and the git state of the checkout holding it) and
saves the file, as the JAX package does; the port's version equals the
JAX package's, so a project either package trained opens in the other
without a warning.
"""

from __future__ import annotations

import os
import re
import subprocess
from pathlib import Path

import numpy as np

from multiplanarunet_tpu_torch.hyperparameters.yaml_reader import safe_load
from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger

_GROUP_RE = re.compile(r"^(?![ \t\n#])([A-Za-z_][^\s:]*):", re.MULTILINE)


def _git_info(repo_dir):
    """(branch, commit) of the git checkout at repo_dir, or Nones where
    there is no checkout or no git."""
    def run(*args):
        try:
            return subprocess.run(
                ["git", *args], cwd=repo_dir, capture_output=True, text=True,
                timeout=5).stdout.strip() or None
        except (OSError, subprocess.SubprocessError):
            return None

    return run("rev-parse", "--abbrev-ref", "HEAD"), run("rev-parse", "HEAD")


class VersionController:
    """The package's version and the git branch and commit of the checkout
    holding it, for stamping project files; in a git checkout it can move
    the checkout to a version tag, branch or commit (port of the JAX
    package's `VersionController`)."""

    def __init__(self, logger=None):
        import multiplanarunet_tpu_torch

        self.logger = logger or ScreenLogger()
        self.version = multiplanarunet_tpu_torch.__version__
        self.git_path = str(Path(multiplanarunet_tpu_torch.__file__)
                            .parent.parent)
        self.branch, self.commit = _git_info(self.git_path)

    def check_git(self):
        """True when the package sits inside a usable git checkout."""
        return (self.commit is not None
                and os.path.exists(os.path.join(self.git_path, ".git")))

    def _git(self, *args):
        out = subprocess.run(["git", *args], cwd=self.git_path,
                             capture_output=True, text=True, timeout=30)
        if out.returncode != 0:
            raise OSError(f"git {' '.join(args)} failed: "
                          f"{out.stderr.strip()}")
        return out.stdout.strip()

    def set_branch(self, branch):
        """Check the package's checkout out at `branch` (a branch or tag
        name)."""
        if not self.check_git():
            raise OSError(
                f"'{self.git_path}' is not a git checkout; cannot switch "
                f"versions of an installed (non-git) package.")
        self._git("checkout", str(branch))
        self.branch, self.commit = _git_info(self.git_path)

    def set_commit(self, commit_id):
        """Hard-reset the package's checkout to `commit_id`."""
        if not self.check_git():
            raise OSError(f"'{self.git_path}' is not a git checkout.")
        self._git("reset", "--hard", str(commit_id))
        self.branch, self.commit = _git_info(self.git_path)

    def set_version(self, version):
        """Check out the version tag or branch ``v<version>`` (a leading
        'v' of `version` is dropped)."""
        version = str(version).lower().strip(" v")
        self.set_branch(f"v{version}")

    def check_or_warn(self, recorded_version, logger=None):
        logger = logger or self.logger
        if recorded_version and str(recorded_version) != str(self.version):
            logger.warn(
                f"Parameter file created under framework version "
                f"'{recorded_version}' but the installed version is "
                f"'{self.version}'. Results may differ.")


class YAMLHParams(dict):
    """Dict of hyperparameter groups + the raw YAML string."""

    def __init__(self, yaml_path, logger=None, no_log=False,
                 no_version_control=False):
        super().__init__()
        self.logger = logger or ScreenLogger()
        self.yaml_path = os.path.abspath(str(yaml_path))
        self.project_path = os.path.split(self.yaml_path)[0]
        self.no_log = no_log
        if not os.path.exists(self.yaml_path):
            raise OSError(f"YAML path '{self.yaml_path}' does not exist")
        with open(self.yaml_path) as f:
            self.string_rep = f.read()
        parsed = safe_load(self.string_rep) or {}
        self.update({k: v for k, v in parsed.items()
                     if not str(k).startswith("__CB")})
        if not no_log:
            self.logger(f"YAML path:    {self.yaml_path}")
        if not no_version_control:
            vc = VersionController(logger=self.logger)
            vc.check_or_warn(self.get("__VERSION__"), self.logger)
            for name, value in (("__VERSION__", vc.version),
                                ("__BRANCH__", vc.branch),
                                ("__COMMIT__", vc.commit)):
                if value is not None:
                    self.set_value(None, name, value, overwrite=True,
                                   add_if_missing=True, log=False)
            self.save_current()

    @property
    def groups(self):
        """Top-level group names in file order (from the raw string)."""
        return [m.group(1) for m in _GROUP_RE.finditer(self.string_rep)]

    def _group_span(self, group_name):
        """(start, end) character span of a group's text in string_rep."""
        matches = list(_GROUP_RE.finditer(self.string_rep))
        for i, m in enumerate(matches):
            if m.group(1) == group_name:
                end = (matches[i + 1].start() if i + 1 < len(matches)
                       else len(self.string_rep))
                return m.start(), end
        raise KeyError(f"No group '{group_name}' in YAML string")

    def get_group(self, group_name):
        """The raw text of one top-level group."""
        start, end = self._group_span(group_name)
        return self.string_rep[start:end]

    def add_group(self, yaml_string):
        """Append a one-group YAML snippet to the text and the dict."""
        yaml_string = yaml_string.strip("\n")
        (group_name, value), = safe_load(yaml_string).items()
        self[group_name] = value
        self.string_rep = (self.string_rep.rstrip("\n") + "\n\n"
                           + yaml_string + "\n")

    def delete_group(self, group_name):
        """Remove one top-level group from the text and the dict."""
        start, end = self._group_span(group_name)
        self.string_rep = self.string_rep[:start] + self.string_rep[end:]
        del self[group_name]

    def log(self):
        for key in self:
            self.logger(f"{key}\t\t{self[key]}")

    def get_from_anywhere(self, key, default=None):
        """Search all groups for `key`; error-log if it appears in
        several, and return the first."""
        hits = []
        for group_name, group in self.items():
            try:
                present = key in group
            except TypeError:
                present = False
            if present:
                hits.append((group_name, group[key]))
        if len(hits) > 1:
            self.logger(f"[ERROR] Found key '{key}' in multiple groups "
                        f"({[h[0] for h in hits]})")
        return hits[0][1] if hits else default

    # --------------------------------------------------------------- editing
    @staticmethod
    def _format_value(value):
        if isinstance(value, np.ndarray):
            return np.array2string(value, separator=", ")
        if value is None:
            return "Null"
        return str(value)

    @staticmethod
    def _rewrite_line(text, name, str_value):
        """`text` with the value of its first 'name:' line replaced; None
        if there is no such line."""
        lines = text.split("\n")
        for i, line in enumerate(lines):
            stripped = line.lstrip()
            if (stripped.startswith(name)
                    and stripped[len(name):].lstrip().startswith(":")):
                indent = line[:len(line) - len(stripped)]
                lines[i] = f"{indent}{name}: {str_value}"
                return "\n".join(lines)
        return None

    def set_value(self, subdir, name, value, overwrite=False,
                  add_if_missing=True, log=True):
        """Set `name` (under group `subdir`, or top-level for None) in the
        dict and in the raw text, keeping every other line as it is. A
        value already set (not None) is kept unless overwrite."""
        str_value = self._format_value(value)
        status = None
        if subdir is None:
            exists = name in self
            if exists and self.get(name) is not None and not overwrite:
                status = (f"Item '{name}' already set with value "
                          f"'{self[name]}'. Skipping (overwrite=False).")
            elif exists:
                new = self._rewrite_line(self.string_rep, name, str_value)
                if new is None:
                    raise AttributeError(f"No line found for field '{name}'")
                self.string_rep = new
                self[name] = value
            elif not add_if_missing:
                raise AttributeError(
                    f"Entry '{name}' does not exist (add_if_missing=False)")
            else:
                self.string_rep = (self.string_rep.rstrip("\n")
                                   + f"\n\n{name}: {str_value}\n")
                self[name] = value
        elif subdir not in self:
            if not add_if_missing:
                raise AttributeError(f"Subdir '{subdir}' does not exist")
            self.add_group(f"{subdir}:\n  {name}: {str_value}")
            status = f"Created subdir '{subdir}' (add_if_missing=True)"
        else:
            exists = name in self[subdir]
            if exists and self[subdir].get(name) is not None \
                    and not overwrite:
                status = (f"Entry '{name}' already set in subdir "
                          f"'{subdir}' with value '{self[subdir][name]}'. "
                          f"Skipping (overwrite=False).")
            elif exists:
                start, end = self._group_span(subdir)
                new = self._rewrite_line(self.string_rep[start:end], name,
                                         str_value)
                if new is None:
                    raise AttributeError(
                        f"No line for field '{name}' in group '{subdir}'")
                self.string_rep = (self.string_rep[:start] + new
                                   + self.string_rep[end:])
                self[subdir][name] = value
            elif not add_if_missing:
                raise AttributeError(f"Entry '{name}' not in subdir "
                                     f"'{subdir}' (add_if_missing=False)")
            else:
                start, end = self._group_span(subdir)
                group_text = self.string_rep[start:end].rstrip(" \n")
                self.string_rep = (self.string_rep[:start] + group_text
                                   + f"\n  {name}: {str_value}\n"
                                   + self.string_rep[end:])
                self[subdir][name] = value
        if log:
            self.logger(status or
                        f"Setting value '{str_value}' (type "
                        f"{type(value).__name__}) in subdir '{subdir}' with "
                        f"name '{name}'")

    def save_current(self, out_path=None):
        """Write the raw text (with every edit) to `out_path` or the file
        it was read from."""
        out_path = os.path.abspath(out_path or self.yaml_path)
        if not self.no_log:
            self.logger(f"Saving current YAML configuration to file: "
                        f"{out_path}")
        with open(out_path, "w") as f:
            f.write(self.string_rep)
