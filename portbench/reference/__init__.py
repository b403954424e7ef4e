"""The plain reference the benchmark judges the program by: PyTorch and
NumPy only, float32 (the sampler float64) with TF32 off. It imports
nothing of the program. Weights, volumes, subjects and views come from
`portbench.traffic`; the training check's window stretch starts from the
program's state copied before the window's first step, and the Elastic
reference deforms with the augmenter's noise draws (random input)."""
