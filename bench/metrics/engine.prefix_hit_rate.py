"""Pages taken from the prefix cache over the pages that could have
been (each prompt's full pages but the one holding its last token), over
the requests admitted in the window; nothing to read where no prompt
had such a page."""

from h100bench import window


def read(run):
    page = run.workload["engine"]["page"]
    adm = window.admitted_in(run.results, run.start, run.end)
    need = sum((r.prompt_len - 1) // page for r in adm)
    if need == 0:
        return None
    return 100.0 * sum(r.prefix_blocks for r in adm) / need
