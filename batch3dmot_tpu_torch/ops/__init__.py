"""Graph operators and the Hopper kernels with their plain versions."""
