"""Admitted prompt tokens over the rows x padded length that the engine prefilled,
over the admissions of the calls completed in the window (`ServeEngine.admitted` and the prompts), in %."""


def read(r):
    if r["kind"] != "serve" or not r["prefill_rows_tokens"]:
        return None
    return 100.0 * r["prompt_tokens"] / r["prefill_rows_tokens"]
