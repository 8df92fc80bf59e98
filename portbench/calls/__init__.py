"""Call shapes, one a file, found by a traffic mix's "call":
calls/<name>.py's `Call(cfg, arrays, schedule, device, fields)`, a
core.program.Program whose `call(k, after_step=None)` runs the mix's
call k on the program."""
