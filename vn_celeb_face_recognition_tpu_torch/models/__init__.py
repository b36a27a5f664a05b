"""NCHW ``nn.Module``s with the torch reference's state_dict keys."""
