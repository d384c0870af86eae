"""Classical controllers of the PyTorch port, as plain functions on tensors."""
