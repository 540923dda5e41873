from dreamfusion_torch.models.networks import build_model  # noqa: F401
