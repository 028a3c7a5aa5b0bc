"""Operator tooling of the port (``ps_admin``)."""
