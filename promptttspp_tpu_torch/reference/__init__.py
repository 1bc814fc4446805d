"""Plain references of the port's models, written out straightforwardly
for the comparisons that hold the port to them; they import nothing of
the port."""
