"""Compute kernels: SE(3) math, ORB frontend, Hamming matching,
RANSAC PnP, Levenberg-Marquardt solvers, triangulation, depth lookup,
pose-graph relaxation."""
