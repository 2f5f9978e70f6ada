"""The examples' shared command line: `--device`."""
from __future__ import annotations

import argparse


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser described by the first line of `doc`, with
    `--device` (default "cuda")."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the partitions: cuda (default) "
                    "or cpu")
    return ap
