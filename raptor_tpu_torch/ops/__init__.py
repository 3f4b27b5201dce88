"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: `rollout` (constant-action RK4 rollout) and `eval` (closed-loop
policy evaluation). `build` compiles `csrc/` at first use."""
