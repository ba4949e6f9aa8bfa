"""The plain references that judge the program's outputs, one module per
kind of configuration, named by a configuration's "reference" key. Each
has `check(samples, config, device, find) -> dict` of the numbers a
configuration's "limits" name: `samples` are the checked lanes of the
window's calls as the loop recorded them, `config` the configuration as
read, and `find(kind, name)` the loader's lookup of a module of the
benchmark by name (the MPC reference finds its plant there). Each
reference rebuilds the problem from the configuration itself. None
imports the program."""
