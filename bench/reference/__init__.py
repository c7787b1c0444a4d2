"""The benchmark's plain reference of its decoders (decoder.py) and its
precision control (precision.py). Nothing here imports the program under
test."""
