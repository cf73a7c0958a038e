"""The plain reference: torch and numpy only, nothing of the program."""
