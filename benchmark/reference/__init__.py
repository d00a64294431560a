"""The plain reference: fbank, the projected-LSTM AM and the graph
arithmetic written out in plain PyTorch and NumPy, float32 with TF32 off
(float64 where a sum is judged).  It imports nothing of the program, of
``jax`` or of the JAX package, and takes nothing the program made: it is
given the benchmark's own inputs (waves, weights drawn from the seed, raw
graph arcs) and the program's outputs only to judge them."""
