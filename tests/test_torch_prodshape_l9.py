"""The level-9 cases of tests/test_torch_prodshape.py: the port's CPU bytes
at 128 KiB shards with 32 KiB of context against the JAX package's sha256
(chip_smoke.py PROD_PINNED).  The squeeze's DP at level 9 takes ~20 s a
case on one CPU thread, so these sit in a file of their own, which the
fast tier's workers run beside the other.  The 8 MiB batch at level 9 is
test_torch_prodshape.py's slow test_headline_batch_equal_pin."""

import pytest

from chip_smoke import PROD_PINNED, prod_id
from test_torch_prodshape import check_port


@pytest.mark.parametrize("case", [c for c in PROD_PINNED
                                  if c[0] == 9 and c[3] < 64], ids=prod_id)
def test_port_bytes_equal_pin(case):
    check_port(case)
