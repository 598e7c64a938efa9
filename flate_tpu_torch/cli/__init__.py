"""Command-line tools of the port: gzip_cli (compress a file on the
device) and gunzip_cli (decompress one on the device)."""
