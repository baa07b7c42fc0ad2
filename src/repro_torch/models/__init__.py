"""LM substrate of the PyTorch port: layers, the attention block stacks
and the model wrapper (the dense, VLM and encoder-decoder families)."""
