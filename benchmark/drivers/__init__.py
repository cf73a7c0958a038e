"""Traffic drivers, one module each, named by a traffic mix's ``driver``."""
