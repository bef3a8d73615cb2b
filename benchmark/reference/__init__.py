"""A frozen plain PyTorch copy of the Go2 convex-MPC controller and plant, in
the dtype of its inputs. It imports nothing of the system it judges."""
