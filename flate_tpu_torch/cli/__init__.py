"""Command-line tools of the port: gzip_cli (compress a file on the
device), gunzip_cli (stream one through the device decoder), roundtrip_cli
(levels 1-9, huffman and store round trips of stdin) and decompress_cli
(three decoders of a raw stream on stdin must agree)."""
