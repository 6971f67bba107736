"""% of its roofline that the fused inverted-residual kernel reaches: the
least time of the chains it ran (``counts.fused_chain_bound_s`` of each of
the cfg's fused chains at the traffic's size and batch, each launch one
chain of a forward) over its summed device time."""

from benchmark import counts


def read(rec):
    ks = [(e - s) for name, s, e, _ in rec['device'] if 'fused_ir' in name]
    lays, t = rec['layers'], rec['traffic']
    chains = counts.fused_chains(lays)
    if not ks or not chains:
        return None
    per_forward = sum(counts.fused_chain_bound_s(lays, ch, t['size'], t['batch'])
                      for ch in chains)
    return 100.0 * per_forward * len(ks) / len(chains) / (sum(ks) / 1e9)
