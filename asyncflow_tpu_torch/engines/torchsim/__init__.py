"""PyTorch counterparts of the reference's ``engines/jaxsim`` (the DES
kernel path of this slice)."""
