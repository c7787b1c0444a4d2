"""The benchmark's plain references, one for each model module of
bench/models/ (decoder.py: the decoders), and its precision control
(precision.py). Nothing here imports the program under test or the
harness."""
