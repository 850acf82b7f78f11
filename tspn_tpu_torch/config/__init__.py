from tspn_tpu_torch.config.config import Config, compute_dtype, get_default_config  # noqa: F401
