"""On-disk vocabulary of scenario files."""
