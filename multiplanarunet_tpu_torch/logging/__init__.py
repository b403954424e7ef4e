"""Project loggers and evaluation result tables."""
