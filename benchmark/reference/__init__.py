"""The plain reference of the benchmark's cells: PyTorch operations in
float32 (TF32 off), written from the reference repository's model,
objective, metrics and optimizer.  It imports nothing of the port, of JAX
or of the JAX package, and takes nothing the program made."""
