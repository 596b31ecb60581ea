"""Examples of the PyTorch port, run as modules
(``python -m gradslam_torch.examples.<name>``)."""
