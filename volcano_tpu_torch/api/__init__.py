"""The API constants the port's packing and generators need."""
