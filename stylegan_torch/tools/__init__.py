"""Scripts of the port: measurements of its kernels on the card, and the
evidence tools of the JAX system's root ``tools/`` (training-quality runs,
the synthetic dataset, serving latency, the fidelity gate)."""
