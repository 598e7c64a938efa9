"""Corpora a mix names by its `corpus` key: module `<name>` here has
make(size, seed) -> bytes, the same bytes for the same size and seed."""

import pathlib

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"


def rfc1951() -> bytes:
    """The text of RFC 1951, the repository's own test text."""
    return (DATA / "rfc1951.txt").read_bytes()
