"""Model zoo of the port (OPT)."""
