"""The plain reference that decides ``correct``.

``stts/`` is a frozen copy of the program's model, loss, DSP, duration,
optimizer, state and step code (plain PyTorch, imports rewritten to the
copy; the alignment step and the sharded meshes left out, and one hook,
``StepContext.generator_precision``, for the control). It imports nothing
of the program and nothing of JAX. ``train.py`` and ``synth.py`` drive it
in float32 with TF32 off; ``precision.py`` holds the control's lower
precision. The benchmark's weights are made here, from the seed, and
handed to both sides.
"""
