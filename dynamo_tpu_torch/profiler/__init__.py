"""The port's profiler package: the GPU catalog (`systems`) and the
roofline sizes the live utilization gauges read (`roofline`). The JAX
package's SLA sweep (`configurator`) and the roofline's `estimate` wait
for the planner."""
