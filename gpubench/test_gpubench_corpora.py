"""The corpora are bench.py's, seeded from --seed."""

import hashlib

from gpubench.corpora import mixed, text

MIB32 = 32 << 20
# sha256 of bench.py's mixed_corpus(32 MiB) (numpy seed 11) and
# text_corpus(32 MiB)
MIXED_11 = "c803cd6d61acf94f101eb83d04a3514065dcd4fce0473dfd8bd3930a30bc4957"
TEXT_0 = "ea126007ac3e9a06b349fd8f79980704b7d46bbe745cc007116972c299f3f806"


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def test_mixed_at_seed_11_is_bench_py_mixed_corpus():
    assert sha(mixed.make(MIB32, 11)) == MIXED_11


def test_text_at_offset_0_is_bench_py_text_corpus():
    assert sha(text.make(MIB32, 0)) == TEXT_0


def test_same_seed_same_bytes_other_seed_other_bytes():
    big = 2**31 + 12345
    for corpus in (mixed, text):
        a = corpus.make(1 << 20, big)
        assert len(a) == 1 << 20
        assert a == corpus.make(1 << 20, big)
        assert a != corpus.make(1 << 20, big + (1 << 40))
