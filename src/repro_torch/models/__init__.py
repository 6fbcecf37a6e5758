"""Model configuration, building blocks and the dense LM."""
