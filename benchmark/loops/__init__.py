"""The loops that drive the program, one module each, named by a traffic
mix's "loop" key. Each module has `setup(ctx)` (`Ctx` in run.py), which
builds the configuration's problem, makes the inputs from the seed and
warms every shape the mix uses, and returns an object with `dims`, the
problem's sizes as the metric readers take them, and `call()`, which runs
one timed call (or closed-loop step) and returns its record: lanes, lanes
meeting the contract, the summed iteration counts, the checked lanes
(`sample`, what the configuration's reference judges), and `relay_s`
where the loop has one. A call ends with the device idle. `cold` and
`track` drive the MPC class (benchmark/mpc_inputs.py); a loop of another
class of problem is a module of its own beside them."""
