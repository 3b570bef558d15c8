from cocodr_tpu_torch.losses.nll import triplet_nll  # noqa: F401
