"""Native (C++) components of the port, built at first use with g++
(build.py) and bound with ctypes: the RecordIO container (recordio.cc, a
copy of the JAX package's backend-neutral source)."""
