"""Model zoo: config, layers, attention, MoE, transformer, registry."""
