"""The plain reference of the benchmark: plain torch, from the cell's inputs
alone.  It imports nothing of the program (``xtddft_tpu_torch``), of the
JAX package or of JAX."""
