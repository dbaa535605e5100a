"""One module a kind of traffic (`kind` in `benchmark/traffic/<name>.json`):
each turns a traffic file's parameters into the calls the window drives,
and checks what they produced against the plain reference."""
