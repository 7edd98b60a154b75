"""Model definitions: configs, parameter specs, layers, transformer."""
