"""Native (C++) components of the port, built at first use with g++
(build.py) and bound with ctypes, each a copy of the JAX package's
backend-neutral source: the RecordIO container (recordio.cc), and the CPU
runtimes over runtime.h, the inference predictor (infer.cc, infer.py's
NativePredictor) and the training runtime (train.cc, train.py's
NativeTrainer). No path on the card calls the runtimes."""
