"""ssd: the Mamba-2 chunked SSD scan, state carried on chip across chunks."""
