"""Command-line workloads (``python -m voxelmorph_tpu_torch.cli.<name>``)."""
