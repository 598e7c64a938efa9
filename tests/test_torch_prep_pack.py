"""B1's keys in their int32 format and B5's plain path against the JAX
package (Pallas in interpret mode).  B1 stores a key as u32 key ^ 2^31 in
int32, so that a signed sort is the u32 order; B5 packs fields given as
int32 u32 bit patterns, and the edge rows lay fields across the kernel's
4,096-field tile ends.  Tolerance: exact (u32 compared as uint32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flate_tpu.jx import encode2 as j_encode2
from flate_tpu.jx import match2 as j_match2
from flate_tpu.jx import pack as j_pack
from flate_tpu.jx import pipeline2 as j_pipeline2

from flate_tpu_torch.device import match2, pack

from _torch_corpora import (KINDS, PACK_EDGES, PACK_TILE, S,
                            pack_edge_rows, tt, u32, windows)

SEG = j_encode2.seg_size(S, 1024)
SLOTS = j_encode2.slot_count(S, SEG)
NWR = j_pipeline2._nwr(S, SEG)
# the JAX packer writes a 5-row window past a group's first word: streams
# stay that far inside its word grid
MAX_BITS = (NWR - 5) * 128 * 32


@pytest.mark.parametrize("hash_bytes", [3, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_prep_keys_flip_back_to_jax(kind, hash_bytes):
    """B1's plain keys are int32 = u32 key ^ 0x80000000; flipped back they
    are the JAX prep's u32 keys, pad positions' sentinel included."""
    win = windows(kind, seed=31)
    jkey, _ = j_match2._prep(jnp.asarray(win), 1, 0, hash_bytes,
                             interpret=True)
    key, _ = match2._prep(tt(win), 1, hash_bytes)
    assert key.dtype == torch.int32
    np.testing.assert_array_equal(u32(match2.key_u32(key)), u32(jkey))
    np.testing.assert_array_equal(u32(key),
                                  u32(jkey) ^ np.uint32(match2.KEY_FLIP))
    assert (u32(jkey)[:, win.shape[1]:] == match2.SENTINEL).all()


@pytest.mark.parametrize("kind", KINDS)
def test_int32_sort_is_the_u32_order(kind):
    """torch.sort of the stored int32 keys puts every real key where the
    u32 sort puts it, and the sentinels of the pad positions last."""
    win = windows(kind, seed=32)
    B, W = win.shape
    key, _ = match2._prep(tt(win), 2, 4)
    s32, o32 = torch.sort(key, dim=1)
    s64, o64 = torch.sort(match2.key_u32(key), dim=1)
    live = s64 != match2.SENTINEL
    assert live.sum(dim=1).tolist() == [W] * B and live[:, :W].all()
    assert torch.equal(match2.key_u32(s32), s64)
    assert torch.equal(o32[live], o64[live])
    jkey, _ = j_match2._prep(jnp.asarray(win), 2, 0, 4, interpret=True)
    np.testing.assert_array_equal(u32(match2.key_u32(s32)),
                                  np.sort(u32(jkey), axis=1))


def test_sort_key_keeps_the_u32_order_at_the_extremes():
    u = torch.tensor([[0xFFFFFFFF, 0x80000000, 0, 0x7FFFFFFF, 1,
                       0xFFFFFFFE, 0x80000001]], dtype=torch.int64)
    stored = match2.sort_key(u)
    assert stored.dtype == torch.int32
    assert torch.equal(match2.key_u32(stored), u)
    assert torch.equal(torch.sort(stored, dim=1).indices,
                       torch.sort(u, dim=1).indices)


@pytest.mark.parametrize("edge", PACK_EDGES)
def test_pack_edges_equal_jax(edge):
    """pack_fields (plain path) on each edge row of pack_edge_rows, beside
    the next one, against the JAX packer: fields across every 4,096-field
    tile end, a tile of dead fields, a stream ending on a word boundary at
    a tile end, a tile starting a word, a tile within one word, an empty
    row and a row filled with 28-bit fields."""
    vals, bits = pack_edge_rows(SLOTS, MAX_BITS, seed=3)
    assert SLOTS > 2 * PACK_TILE
    i = PACK_EDGES.index(edge)
    rows = [i, (i + 1) % len(PACK_EDGES)]
    v, b = vals[rows], bits[rows]
    jw, jt = j_pack.pack_fields(jnp.asarray(v), jnp.asarray(b), NWR,
                                interpret=True)
    tw, tt_ = pack.pack_fields(tt(v.view(np.int32)), tt(b), NWR)
    assert tw.dtype == torch.int32 and tt_.dtype == torch.int32
    np.testing.assert_array_equal(u32(tw), u32(jw))
    np.testing.assert_array_equal(tt_.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tt_.numpy(), b.astype(np.int64).sum(1))
    if edge == "empty":
        assert not u32(tw)[0].any()


def test_pack_narrows_int64_values():
    """int64 u32 values (another caller's width) pack as their int32 bit
    patterns do, values with the top bit set included."""
    vals, bits = pack_edge_rows(SLOTS, MAX_BITS, seed=4)
    vals = np.where(bits == 28, vals | np.uint32(0x0F000000), vals)
    bits = np.where(bits == 28, 32, bits).astype(np.int32)
    vals = np.where(bits == 32, vals | np.uint32(0x80000000), vals)
    w64, t64 = pack.pack_fields(tt(vals.astype(np.int64)), tt(bits), NWR)
    w32, t32 = pack.pack_fields(tt(vals.view(np.int32)), tt(bits), NWR)
    assert torch.equal(w64, w32) and torch.equal(t64, t32)
    assert (u32(w32) >= 0x80000000).any()
