"""The least time of the encode's kernels, by the bytes each must move.

A frozen copy of chip_smoke.py's arithmetic (its `case` calls for B1-B5
and B9): each input read once and each output written once, at the
kernel's own widths, over the H100's memory rate.  `launch_bytes` gives
them as functions of a batch's shapes: B rows of S bytes with ctx bytes
of context, at a level's parse block.  The constants are the program's
shapes as chip_smoke.py read them; they are copied so that no change to
the program moves the yardstick."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory rate (data sheet)
TILE = 8192                        # B1's key rows are padded to this
HDR_SLOTS = 655                    # field slots of a block header
PACK_WIN = 640                     # B5's placement window (words)
MAX_STORED = 65535                 # bytes of a stored block
# parse-block size by level (the last knob of the level table)
PARSE_BLOCK = {1: 1024, 2: 1024, 3: 1024, 4: 1024, 5: 1024, 6: 1024,
               7: 4096, 8: 4096, 9: 4096}


def _seg_size(S: int, blk: int) -> int:
    """Bytes of a segment: parse-block aligned, at most a stored block,
    about 32 a shard."""
    nblk = -(-S // blk)
    return min(blk * max(1, -(-nblk // 32)), (MAX_STORED // blk) * blk)


def _slots(S: int, seg: int) -> int:
    """Field slots of a shard's row (padded to 512)."""
    raw = -(-S // seg) * (4 + HDR_SLOTS) + 2 * S + 4
    return -(-raw // 512) * 512


def _word_rows(S: int, seg: int) -> int:
    """Rows of 128 words that bound a shard's stream."""
    worst_bits = 8 * S + 44 * (-(-S // seg) + 2) + 256
    return -(-worst_bits // (32 * 128)) + PACK_WIN // 128


def launch_bytes(B: int, S: int, ctx: int, level: int) -> dict:
    """Kernel name -> bytes one launch must move on a batch of B rows of
    S bytes with ctx bytes of context (fingerprint words off, as at every
    level)."""
    W = ctx + S                          # a row's window
    Wp = -(-W // TILE) * TILE
    blk = min(PARSE_BLOCK[level], S)
    while S % blk:
        blk //= 2
    seg = _seg_size(S, blk)
    walk = 5 * B * S                     # i32 steps in, u8 mask out
    return {
        # window in; u32 key a position out
        "prep_kernel": B * W + B * Wp * 4,
        # sorted u32 keys, window, min_src and limit in; u32 (len, dist) out
        "matcher_kernel": B * Wp * 4 + B * W + 8 * B + B * W * 4,
        # window in; u32 len and dist out
        "small_runs_kernel": B * W + 2 * B * W * 4,
        # u32 len and dist in; u32 len out
        "extend_kernel": 3 * B * W * 4,
        "parse_rows_kernel": walk,
        "parse_ring_kernel": walk,
        # u32 field values and widths in; the words out
        "pack_kernel": (8 * B * _slots(S, seg)
                        + 4 * B * _word_rows(S, seg) * 128),
    }
