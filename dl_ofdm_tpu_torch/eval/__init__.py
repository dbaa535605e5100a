"""BER-vs-SNR sweep protocols and the result CSV schema."""
