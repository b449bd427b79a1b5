"""Model zoo of the port: configs schema, layers, attention, transformer."""
