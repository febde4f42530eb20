"""Set-up seconds of the compile layer, summed over the instances: the
port's builder, ClusteredLowRankSDP, remove_empty_blocks, preprocess_sdp
and DeviceSDP (set-up steps 1-4), on the harness's clock."""


def read(run):
    return sum(run.host_build_s)
