"""Errors raised by the port."""


class FlateError(Exception):
    """Base class for the port's errors."""


class DeviceUnavailable(FlateError, RuntimeError):
    """A CUDA device was asked for and none is present.  The port never
    falls back to the CPU on its own: the caller names the device."""


class EndOfStream(FlateError):
    """Input ended mid-stream."""


# --- container framing ---

class BadGzipHeader(FlateError):
    pass


class BadZlibHeader(FlateError):
    pass


class WrongGzipChecksum(FlateError):
    pass


class WrongGzipSize(FlateError):
    pass


class WrongZlibChecksum(FlateError):
    pass


# --- inflate ---

class InvalidCode(FlateError):
    pass


class InvalidMatch(FlateError):
    pass


class InvalidBlockType(FlateError):
    pass


class WrongStoredBlockNlen(FlateError):
    pass


class InvalidDynamicBlockHeader(FlateError):
    pass


# --- Huffman code-length sets ---

class OversubscribedHuffmanTree(FlateError):
    pass


class IncompleteHuffmanTree(FlateError):
    pass


class MissingEndOfBlockCode(FlateError):
    pass


# --- bit writer invariant ---

class UnfinishedBits(FlateError):
    pass
