"""Model code of the port: config registry, layers, transformer, converters."""
