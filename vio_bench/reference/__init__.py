"""The plain reference the benchmark holds the program to.

A frozen copy of the PyTorch port's step as plain PyTorch, made when the
benchmark was defined: ``configs``, ``types``, ``camera``, ``so3``,
``linalg``, ``scale_space``, ``edge_detect``, ``distance_field``,
``tracker``, ``matching``, ``imu``, ``sab`` and ``pipeline`` are the
program's modules of those names with their imports pointed here, and
``kernels`` holds only the plain versions of the CUDA kernels.  Nothing here
imports the program: a later change to the program is held to the step as
it was.  ``oracle`` is the entry the benchmark calls."""
