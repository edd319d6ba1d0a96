"""The diffusion pipeline's models: the text encoder, the DiT and the AE decoder."""
