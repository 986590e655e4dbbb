"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on NVIDIA
H100 cards: ``python3 -m portbench.run --workload NAME --seed N --seconds S
--trace 0|1`` (see ``run.py``).  Nothing here imports JAX or the JAX
package; ``reference/`` imports nothing of the program either."""
