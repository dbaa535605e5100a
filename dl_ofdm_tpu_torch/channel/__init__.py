"""AWGN and 3GPP Rayleigh channels, fractional-delay FIR."""
