"""Project loggers: multi-file disk logger + print-only stand-in.

A copy of `multiplanarunet_tpu/logging/loggers.py`: multi-file logs under
<project>/logs (or a given folder), per-call out_file routing, caller
attribution, a warnings file, thread safety and overwrite protection.
"""

from __future__ import annotations

import inspect
import os
import threading
from pathlib import Path


class ScreenLogger:
    """Print-only logger with the same call surface as `Logger`."""

    def __init__(self, print_to_screen=True):
        self.print_to_screen = print_to_screen
        self.print_calling_method = False

    def __call__(self, *args, **kwargs):
        if self.print_to_screen and not kwargs.get("no_print", False):
            print(*args)

    def warn(self, *args, **kwargs):
        if self.print_to_screen and not kwargs.get("no_print", False):
            print("[WARNING]", *args)

    def __repr__(self):
        return f"ScreenLogger(print_to_screen={self.print_to_screen})"


class Logger:
    """Logger writing to one or more text files under <project>/logs.

    Each call may route to a different file via `out_file`; the first message
    written by a new calling function is annotated with the caller's name
    (suppressible per-call or globally via `print_calling_method`).
    """

    def __init__(self, base_path, print_to_screen=True, active_file=None,
                 overwrite_existing=False, print_calling_method=True,
                 no_sub_folder=False, log_prefix=""):
        self.base_path = Path(base_path).absolute()
        if no_sub_folder:
            self.path = self.base_path
        else:
            self.path = self.base_path / "logs"
        self.path.mkdir(parents=True, exist_ok=True)

        self.print_to_screen = print_to_screen
        self.overwrite_existing = overwrite_existing
        self.print_calling_method = print_calling_method
        self.log_prefix = str(log_prefix)

        self._lock = threading.Lock()
        self._open_files = {}
        self._last_caller_by_file = {}
        self.active_log_file = active_file or "log"

    # ----------------------------------------------------------------- files
    @property
    def active_log_file(self):
        return self._active_log_file

    @active_log_file.setter
    def active_log_file(self, name):
        self._active_log_file = name
        self._ensure_file(name)

    def _file_path(self, name):
        return self.path / f"{self.log_prefix}{name}.txt"

    def _ensure_file(self, name):
        if name in self._open_files:
            return self._open_files[name]
        fpath = self._file_path(name)
        if fpath.exists() and not self.overwrite_existing:
            raise OSError(
                f"Log file '{fpath}' already exists. Pass "
                f"overwrite_existing=True or move the existing file."
            )
        self._open_files[name] = open(fpath, "w", buffering=1)
        return self._open_files[name]

    # --------------------------------------------------------------- logging
    def _caller_name(self):
        # Walk out of this module to find the calling function
        for frame_info in inspect.stack()[2:]:
            mod = frame_info.frame.f_globals.get("__name__", "")
            if not mod.startswith("multiplanarunet_tpu_torch.logging"):
                return f"{mod}.{frame_info.function}"
        return "<unknown>"

    def __call__(self, *args, print_to_screen=None, out_file=None,
                 print_calling_method=None, no_print=False, sep=" ", end="\n"):
        if no_print:
            print_to_screen = False
        out_file = out_file or self.active_log_file
        msg = sep.join(str(a) for a in args)
        with self._lock:
            f = self._ensure_file(out_file)
            annotate = (
                self.print_calling_method
                if print_calling_method is None
                else print_calling_method
            )
            caller = self._caller_name() if annotate else None
            if caller and self._last_caller_by_file.get(out_file) != caller:
                self._last_caller_by_file[out_file] = caller
                f.write(f">>> Logged by: {caller}\n")
            f.write(msg + end)
            show = self.print_to_screen if print_to_screen is None else print_to_screen
            if show:
                print(msg, end=end)

    def warn(self, *args, **kwargs):
        kwargs["out_file"] = kwargs.get("out_file") or "warnings"
        self.__call__("[WARNING]", *args, **kwargs)

    def close(self):
        with self._lock:
            for f in self._open_files.values():
                f.close()
            self._open_files.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __repr__(self):
        return f"Logger(base_path={self.base_path})"
