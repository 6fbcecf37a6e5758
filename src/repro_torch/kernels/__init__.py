"""The two hand-written CUDA epilogue kernels, their plain versions and
the public ops around them."""
