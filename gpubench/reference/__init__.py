"""The plain reference that judges the program's answers: a DEFLATE
decoder written from RFC 1951 (`inflate`), CRC-32 and Adler-32 written
from RFC 1952 and RFC 1950 (`checksums`), and the check of a whole member
against the bytes it was made from (`member`).  Plain Python and NumPy:
nothing here imports torch, jax or any part of the program."""
