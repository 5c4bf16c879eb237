"""Random-decision-forest application (batch/speed/serving tiers) of the
PyTorch port."""
