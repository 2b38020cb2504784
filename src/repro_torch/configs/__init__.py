from repro_torch.configs.registry import get_config, list_archs, canonical  # noqa: F401
