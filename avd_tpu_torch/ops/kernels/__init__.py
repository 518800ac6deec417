"""Hand-written CUDA kernels of the port and their wrappers.

Each wrapper module holds the kernel's plain PyTorch version, a launch
counter (``LAUNCHES``, a plain int raised once per kernel launch and
nowhere else, under ``_launches.count``'s lock: windows launch from
several host threads) and the ctypes binding.  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.
"""
