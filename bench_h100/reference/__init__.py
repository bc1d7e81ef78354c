"""Plain PyTorch references that decide ``correct``.  They import nothing
of the port (``repro_torch``) and take nothing that the port made."""
