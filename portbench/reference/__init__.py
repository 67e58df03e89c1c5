"""Plain references of what the benchmark's cells compute; they import
nothing of the program under test."""
