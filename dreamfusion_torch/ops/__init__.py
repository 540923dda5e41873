"""Numerical ops of the port: encoders, compositing, marching and the
hand-written CUDA kernels' wrappers (see ops/cuda.py)."""
