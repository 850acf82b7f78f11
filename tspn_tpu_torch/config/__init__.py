from tspn_tpu_torch.config.config import Config, get_default_config  # noqa: F401
