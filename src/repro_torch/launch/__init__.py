"""Hardware constants and analytic costs the tuner and the chip smoke share."""
