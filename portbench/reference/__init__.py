"""Plain PyTorch references of the benchmark's configurations. They
import neither ``jax`` nor the JAX package nor anything of the port, and
take only the benchmark's own inputs (the weight tree it drew, the
prompts, the batches)."""
