"""Seeded scene and overlay generators, one module each, found by the name
a configuration or traffic file gives."""
