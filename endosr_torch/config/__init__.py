"""YAML options of the port's entry points."""
