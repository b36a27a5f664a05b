"""The benchmark's plain reference: the detectors, alignment and networks
written with stock PyTorch operations, run in float32 with TF32 off."""
