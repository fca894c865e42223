"""SD-2.1 UNet, VAE and CLIP text tower as `nn.Module`s over diffusers keys."""
