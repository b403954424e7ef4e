"""The port's Logger names the function that logged, as the JAX Logger
does.

Both loggers write `>>> Logged by: <module>.<function>` before the first
line of each new caller in a file. The same calls, made through each
package's Logger from the same functions of this module, must write the
same files: from a function, a method, a nested function, through
`warn` (whose own frame lies in the logging module and is skipped), and
with the annotation turned off per call.
"""
import pytest

from multiplanarunet_tpu.logging.loggers import Logger as JaxLogger
from multiplanarunet_tpu_torch.logging.loggers import Logger
from tests.torch_projects import torch_threads  # noqa: F401


def log_from_function(logger, text):
    logger(text)


class Caller:
    def log(self, logger, text):
        logger(text)


def log_from_nested(logger, text):
    def inner():
        logger(text)

    inner()


def warn_from_function(logger, text):
    logger.warn(text)


def log_unannotated(logger, text):
    logger(text, print_calling_method=False)


CALLS = {
    "function": log_from_function,
    "method": Caller().log,
    "nested": log_from_nested,
    "warn": warn_from_function,
    "unannotated": log_unannotated,
}


def _files(cls, root, calls):
    logger = cls(root, print_to_screen=False, active_file="log")
    for name in calls:
        CALLS[name](logger, f"{name} once")
        CALLS[name](logger, f"{name} twice")
    logger("from the test")
    logger.close()
    return {p.name: p.read_text() for p in sorted((root / "logs").iterdir())}


@pytest.mark.parametrize("calls", [list(CALLS), ["warn", "nested", "warn"],
                                   ["unannotated", "function", "method"]])
def test_caller_lines_equal_the_jax_loggers(tmp_path, calls):
    port = _files(Logger, tmp_path / "port", calls)
    jax = _files(JaxLogger, tmp_path / "jax", calls)
    assert port == jax
    assert (f">>> Logged by: {__name__}.log_from_function\n" in port["log.txt"]
            or "function" not in calls)
    assert port["log.txt"].endswith(
        f">>> Logged by: {__name__}._files\nfrom the test\n")

