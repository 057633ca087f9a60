"""PyTorch counterparts of the reference's ``engines/jaxsim``: the DES
kernel path (``kernel_engine``, ``des_kernel``, ``des_reference``) and the
scan fast path (``fastpath``, ``draws``, ``station_scan``, ``sortutil``)."""
