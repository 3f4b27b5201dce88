from raptor_tpu_torch.rl import evaluation  # noqa: F401
