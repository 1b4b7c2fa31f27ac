"""Options and state conversion."""
