"""Protocol constants for DEFLATE (RFC 1951) and its containers (RFC 1950/1952).

The port's own copy of the constants the device encoder uses; values are
held equal to `flate_tpu.consts` by tests/test_torch_tables.py.
"""

# --- match/token limits ---
MIN_MATCH_LEN = 3
MAX_MATCH_LEN = 258
MIN_DISTANCE = 1
MAX_DISTANCE = 32768     # 32K history window

# --- windows / blocks ---
HISTORY_LEN = 32 * 1024
MAX_STORED_BLOCK = 65535         # stored block length field is u16

# Shard size of the data-parallel pipeline: each shard is an independent run
# of deflate blocks ending in a sync flush (pigz-style), primed with the
# previous HISTORY_LEN bytes unless shards are independent.
SHARD_LEN = 128 * 1024

# --- alphabets ---
NUM_LITLEN = 286                 # literal/length alphabet actually used
NUM_LITLEN_CODES = 288           # incl. the two reserved codes in fixed trees
NUM_DIST = 30
NUM_DIST_CODES = 32
NUM_CODEGEN = 19                 # code-length ("codegen") alphabet
END_OF_BLOCK = 256

MAX_CODE_BITS = 15               # litlen/dist code length limit
MAX_CODEGEN_BITS = 7             # codegen code length limit

# Order in which codegen code lengths are stored in a dynamic header
# (RFC 1951 §3.2.7).
CODEGEN_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)

# --- hashing ---
LOOKUP_BITS = 15                 # hash width of the round-1 matcher
HASH_MUL = 0x9E3779B1            # Fibonacci hashing multiplier

# --- levels ---
# level: (candidates, nice, lazy_enabled, max_lazy) of the round-1 encoder
# (device/pipeline.py) and the host tail encoder (deflate.py): candidates
# = the most recent same-hash positions scored a position, max_lazy = the
# length at and above which a match is taken without deferral
LEVEL_PARAMS = {
    1: (2, 16, False, 0),
    2: (4, 24, False, 0),
    3: (8, 32, False, 0),
    4: (8, 16, True, 4),
    5: (32, 32, True, 16),
    6: (64, 128, True, 32),
    7: (96, 144, True, 64),
    8: (128, 258, True, 128),
    9: (192, 258, True, 258),
}

LEVEL_FAST = 4
LEVEL_DEFAULT = 6
LEVEL_BEST = 9
