"""`mp version` on the PyTorch port: print the package's version and git
state; optionally move the package's checkout to another version tag,
branch or commit.

Port of `multiplanarunet_tpu/bin/version.py`, over the port's
`VersionController`. Run as ``python -m multiplanarunet_tpu_torch.bin.mp
version [--checkout VER | --branch B | --commit C]``.
"""

from __future__ import annotations

from argparse import ArgumentParser


def get_argparser():
    parser = ArgumentParser(description="Report (or switch) the framework "
                                        "version")
    parser.add_argument("--checkout", type=str, default=None, metavar="VER",
                        help="Check the package git repo out at version tag "
                             "v<VER> (e.g. --checkout 0.3.1)")
    parser.add_argument("--branch", type=str, default=None,
                        help="Check the package git repo out at this "
                             "branch/tag")
    parser.add_argument("--commit", type=str, default=None,
                        help="Hard-reset the package git repo to this commit")
    return parser


def entry_func(args=None):
    from multiplanarunet_tpu_torch.hyperparameters.hparams import (
        VersionController,
    )

    args = get_argparser().parse_args(args)
    vc = VersionController()
    if args.checkout:
        vc.set_version(args.checkout)
    if args.branch:
        vc.set_branch(args.branch)
    if args.commit:
        vc.set_commit(args.commit)
    print(f"version: {vc.version}")
    print(f"branch:  {vc.branch}")
    print(f"commit:  {vc.commit}")


if __name__ == "__main__":
    entry_func()
