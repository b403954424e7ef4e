"""A project's train_hparams.yaml, read only.

Port of the reading half of `multiplanarunet_tpu/hyperparameters/
hparams.py:YAMLHParams`: a dict of config groups parsed from the file
(groups prefixed __CB, the callback anchor definitions, are dropped),
the raw text, group lookup and `get_from_anywhere`. Parsing goes through
`yaml_reader.safe_load`. Writing and version stamping stay with the JAX
package's training scripts.
"""

from __future__ import annotations

import os
import re

from multiplanarunet_tpu_torch.hyperparameters.yaml_reader import safe_load
from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger

_GROUP_RE = re.compile(r"^(?![ \t\n#])([A-Za-z_][^\s:]*):", re.MULTILINE)


class YAMLHParams(dict):
    """Dict of hyperparameter groups + the raw YAML string."""

    def __init__(self, yaml_path, logger=None, no_log=False):
        super().__init__()
        self.logger = logger or ScreenLogger()
        self.yaml_path = os.path.abspath(str(yaml_path))
        self.project_path = os.path.split(self.yaml_path)[0]
        if not os.path.exists(self.yaml_path):
            raise OSError(f"YAML path '{self.yaml_path}' does not exist")
        with open(self.yaml_path) as f:
            self.string_rep = f.read()
        parsed = safe_load(self.string_rep) or {}
        self.update({k: v for k, v in parsed.items()
                     if not str(k).startswith("__CB")})
        if not no_log:
            self.logger(f"YAML path:    {self.yaml_path}")

    @property
    def groups(self):
        """Top-level group names in file order (from the raw string)."""
        return [m.group(1) for m in _GROUP_RE.finditer(self.string_rep)]

    def get_group(self, group_name):
        """The raw text of one top-level group."""
        matches = list(_GROUP_RE.finditer(self.string_rep))
        for i, m in enumerate(matches):
            if m.group(1) == group_name:
                end = (matches[i + 1].start() if i + 1 < len(matches)
                       else len(self.string_rep))
                return self.string_rep[m.start():end]
        raise KeyError(f"No group '{group_name}' in YAML string")

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
