"""Model layers: attention, transformer blocks, controlled TP linears."""
