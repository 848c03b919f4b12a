"""The launchers (``train``, ``serve``), the meshes of cards (``mesh``), and the
hardware constants and analytic costs the tuner and the chip smoke share."""
