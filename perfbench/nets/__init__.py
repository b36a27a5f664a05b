"""One module a network, found by the name a configuration gives it
(``nets/<net>.py``): ``program(spec, dtype, device, seed)`` builds the
program's object with its weights, ``reference(spec, seed, device)`` the
plain reference's (``perfbench.reference``) with the same weights, and
``flops(spec, ctx)`` counts the net's model FLOPs: a frame for a
detector, a face for the others (``ctx`` as a per-layer reader gets it)."""
