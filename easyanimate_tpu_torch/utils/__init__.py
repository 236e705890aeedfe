"""Host-side helpers: media (numpy; PIL only where an image must be
resized), the safetensors format, fp8 weight storage, yaml model configs."""
