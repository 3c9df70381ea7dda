"""Plain references of what the timed path produces, in numpy, from the
survey's truth. They import nothing of the program."""
