"""The weight bridge, the .pth checkpoint formats and local state-dict loading."""
