"""DDIM sampling with CFG and the SD VAE decoder."""
