"""Command-line helpers."""
