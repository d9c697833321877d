"""Command-line tools of the port that measure it on the card."""
