"""Plain references of the codec formats; they import nothing of the
program under test."""
