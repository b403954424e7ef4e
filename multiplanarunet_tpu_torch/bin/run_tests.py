"""`mp run_tests`: run the port's test files (tests/test_torch_*.py of the
repository) with pytest; `--tests` other than 'all' is a `-k` filter.
Port of `multiplanarunet_tpu/bin/run_tests.py`."""

from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path


def get_argparser():
    parser = ArgumentParser(description="Run the port's test suite")
    parser.add_argument("--tests", type=str, default="all",
                        help="'all' or a pytest -k expression")
    return parser


def pytest_args(args=None):
    """The pytest argument list `entry_func` runs."""
    args = get_argparser().parse_args(args)
    test_dir = Path(__file__).resolve().parents[2] / "tests"
    out = ["-q", *sorted(str(p) for p in test_dir.glob("test_torch_*.py"))]
    if args.tests != "all":
        out += ["-k", args.tests]
    return out


def entry_func(args=None):
    import pytest

    raise SystemExit(pytest.main(pytest_args(args)))


if __name__ == "__main__":
    entry_func()
