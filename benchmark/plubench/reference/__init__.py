"""The benchmark's plain reference: a frozen copy of plutracer_tpu_torch's
plain path (urn evaluation, the scene compile with the Python tree, the
plain integrator, threefry, the camera stage, the tonemap, the train step
and its optimisers), with every kernel dispatch taken out and a
brute-force query by primitive type in place of the program's engines.
It imports nothing of the program: later changes to the program do not
move it."""
