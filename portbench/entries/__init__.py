"""The program's entries, one module each, found by the configuration's
`entry`.  Each gives:

* `build(config, workload, device)`: the state set-up makes once;
* `call(state, request)`: the request through the program, one
  `check.Answer` per source;
* `counters(state)`: the program's own cumulative counters;
* `probes()`: (owner, attribute, span) of the calls a traced run times.
"""
