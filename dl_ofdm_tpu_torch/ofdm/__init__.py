"""OFDM transmitter: constellations, subcarrier plans and the TX operator."""
