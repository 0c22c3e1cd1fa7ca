"""The plain reference of a frame, in plain torch, independent of the program."""
